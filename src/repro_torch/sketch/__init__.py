"""The sliding-sketch API and the fleet query fold."""
