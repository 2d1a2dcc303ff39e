"""The reference that the configuration ``tiny-named`` names: the plain
decoder of ``bench/reference/transformer.py`` under a file of its own, so
that a test can change this module alone and see the run judged by it."""
from bench.reference.transformer import forward, layout, no_tf32  # noqa: F401
