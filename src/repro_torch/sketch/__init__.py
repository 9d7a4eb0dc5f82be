"""The sliding-sketch API and the fleet query fold, and DS-FD in training:

* ``monitor``  — SlidingGradSketch: windowed streaming PCA of gradients;
* ``compress`` — FD low-rank gradient compression with error feedback;
* ``sketchy``  — the sliding-window Sketchy optimizer.

Their public names are exported here, as the reference's package does.
"""

from repro_torch.sketch.compress import (CompressConfig, compress_grads,
                                         compress_init, compressed_psum,
                                         wire_bytes)
from repro_torch.sketch.monitor import (SketchConfig, cohort_sketch_query,
                                        sketch_init, sketch_query,
                                        sketch_score, sketch_update,
                                        subspace_drift)
from repro_torch.sketch.sketchy import SketchyConfig, sketchy_dsfd

__all__ = ["CompressConfig", "SketchConfig", "SketchyConfig",
           "cohort_sketch_query", "compress_grads", "compress_init",
           "compressed_psum", "sketch_init", "sketch_query", "sketch_score",
           "sketch_update", "sketchy_dsfd", "subspace_drift", "wire_bytes"]
