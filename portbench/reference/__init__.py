"""The benchmark's yardstick: input generation from a seed and the plain
reference that decides `correct`.  It imports nothing of the program
(`frozen/` holds copies of the plain host code it needs)."""
