"""The benchmark of ``sbr_rs_tpu_torch`` on one NVIDIA H100: ``run.py`` runs
one cell of ``BENCHMARK.json`` and prints one JSON line. Everything that
measures (traffic, weights, trace reading, FLOP and byte counts, the plain
reference and the comparisons that decide ``correct``) lives in this folder;
the program under test is only called."""
