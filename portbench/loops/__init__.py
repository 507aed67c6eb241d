"""The general generators: each drives one kind of traffic (`traffic/*.json`
names it under "loop") through the program's entry, and hands what its
timed path produced to the reference."""
