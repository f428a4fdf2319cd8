"""Run logging and throughput accounting."""
