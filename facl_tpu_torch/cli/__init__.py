"""Command-line entry points of the port (pretrain / moco / extract /
probe / generate), counterparts of facl_tpu/cli/. Each takes ``--device``
(default ``cuda``; the tests pass ``--device cpu``)."""
