"""Benchmark helpers of the port (only the synthetic data generator so far)."""
