"""Tools beside the benchmark's runs: the faults planted in the program
and the readings over many seeds that set each check's limit."""
