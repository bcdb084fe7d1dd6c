"""The benchmark of the PyTorch and CUDA port (``presto_tpu_torch``).

``run.py`` is the entry point; ``BENCHMARK.json`` at the repository's
root names the cells. Configurations, traffic mixes, queries, plain
references and metric readers are files of their own under this
directory, found by the names that ``BENCHMARK.json`` and the mix files
give.
"""
