"""The port's counterparts of the repository's ``examples/`` drivers.

Each module has ``main(argv=None)`` with the reference driver's flags and
printed lines, plus ``--device`` (``cuda`` by default; ``cpu`` runs it
on the CPU):

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.serve_chain [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.train_small [--device cpu]

Importing a module runs nothing: the drivers build their stores and
endpoints inside functions that the tests and ``chip_smoke.py`` call.
"""
