"""The program mapping that the configuration ``tiny-named`` names: the
default one of ``bench/harness/spec.py`` under a file of its own, so that
a test can change this module alone and see the run serve what it
returns."""
from bench.harness.spec import program_config  # noqa: F401
