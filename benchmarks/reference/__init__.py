"""The plain reference the benchmark judges the program by: NumPy,
pandas and PyTorch only, nothing of the program, nothing it made."""
