"""Input generators of the benchmark: a frozen copy of the program's
renderer, its views rendered in worker processes, and a Lowe-format key
file writer."""
