"""CPU tests of the benchmark (``python -m pytest portbench/tests``), and
one marked ``cuda`` that runs each cell briefly on the card."""
