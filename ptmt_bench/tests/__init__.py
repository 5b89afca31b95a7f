"""CPU tests of the benchmark (test files start with ``test_ptmt_bench_``)."""
