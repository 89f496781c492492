"""The CPU tests of the benchmark's NTU-VIRAL cell `ntu_odom.livo`
(`livo_bench/tests/test_livo_bench_ntu.py`), collected with the repo's
tests."""

from livo_bench.tests.test_livo_bench_ntu import *  # noqa: F401,F403
