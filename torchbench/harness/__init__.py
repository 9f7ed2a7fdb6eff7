"""The general machinery of the benchmark: what no configuration, traffic
mix or metric owns."""
