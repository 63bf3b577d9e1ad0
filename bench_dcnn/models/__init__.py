"""The program's entry points, one file per model family: the only code
of the benchmark that imports ``repro_torch``."""
