"""Host-side tools of the port: the command line (``cli``), preprocessing,
prediction, export, config generation, environment info, db2graph and the
baseline harness, each under its ``marius_tpu/tools`` name."""
