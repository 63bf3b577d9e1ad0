"""One loop per kind of traffic (``kind`` in a mix's file): set-up, the
measured window and the comparison with the reference."""
