"""raybench: the benchmark of ``messyerraytracer_tpu_torch`` on one CUDA card.

    python3 -m raybench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, their configurations, traffic mixes and metrics are named in
the root ``BENCHMARK.json``; each lives in files of its own under this
folder (``configs/``, ``traffic/``, ``metrics/``), found by name.  The
plain reference that decides ``correct`` is ``reference/``: plain
PyTorch, importing nothing of the program.
"""
