"""Operation and byte counts computed from shapes, and the chip's peaks.

These are the benchmark's yardstick: the program is never asked what it
did.  Counts follow the work the function needs (each input byte read
once, each output byte written once), whatever route implements it."""
