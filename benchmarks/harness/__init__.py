"""The benchmark's own machinery: finding a cell's files by name, the
readers' arithmetic, the profiler reading and the byte counts. It imports
nothing of the program; the drivers under ``drivers/`` are the only
code that calls into it."""
