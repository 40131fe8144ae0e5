"""The general parts of the benchmark: finding cells, configurations,
traffic mixes and metric readers by name, making a cell's inputs from the
seed, driving the program through a window, reading the profiler's trace
and printing the result line."""
