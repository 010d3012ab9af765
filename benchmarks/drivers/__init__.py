"""The traffic drivers: each sets up a cell's program from the seed,
runs its window and judges its answers. A traffic file names its
driver; the drivers are the benchmark's only callers of the program."""
