"""The general generators of traffic: one module per kind of mix, each
reading a mix's parameters from bench_port/traffic/<mix>.json."""
