"""The benchmark's own machinery: cells resolved from ``BENCHMARK.json``
and their files (``cell``), inputs made from the seed (``feed``), the
calls into the program (``port``), spans around them (``spans``), the
profiler's trace reduced (``trace``) and the comparison that decides
``correct`` (``check``)."""
