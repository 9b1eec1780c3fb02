"""The plain reference the benchmark judges the program by: plain
PyTorch, importing nothing of the program (``alg1.py``)."""
