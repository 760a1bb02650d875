"""The plain reference the benchmark compares the port with: plain torch
and numpy, importing nothing of the program."""
