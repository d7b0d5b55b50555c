"""The plain reference the benchmark holds the program against: plain
PyTorch in float32, written from the architectures, importing nothing of
the program."""
