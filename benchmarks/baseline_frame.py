"""Single source of truth for the baseline-denominator frame.

PINNED perfect-MPI node size, for ALL artifacts: the denominator frame
must not depend on the bench box's ``os.cpu_count()``, which once shrank
4 → 2 → 1 between bench boxes and silently moved the headline ratio 4×,
and once made ``benchmarks/results.json`` contradict bench.py's pinned
frame. Both ``bench.py`` and ``benchmarks/run_all.py`` import THIS
constant; a regression test
(tests/test_baseline_frame.py) asserts they agree so the two shipping
artifacts can never publish different frames again.

64 = a realistic modern single-node MPI width; see BASELINE.md for the
frame's definition (perfect-MPI = measured single-process NumPy
reference ESS/s × PERFECT_MPI_CORES, i.e. assuming zero communication
cost for the reference — a denominator that flatters the reference).
"""

PERFECT_MPI_CORES = 64
