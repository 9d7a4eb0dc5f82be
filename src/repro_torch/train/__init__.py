"""Persistence shared by fleets and the history plane."""
