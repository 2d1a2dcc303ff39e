"""The program mapping that the configuration ``tiny-mla`` names:
DeepSeek-V2-Lite's (``bench/programs/deepseek_v2_lite.py``) under a file of
its own, so that a test can change this module alone and see the run serve
what it returns."""
from bench.programs.deepseek_v2_lite import program_config  # noqa: F401
