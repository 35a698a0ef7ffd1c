"""Host utilities: scalar logging, profiling, attention plots."""
