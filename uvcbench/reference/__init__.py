"""The plain reference in float32: it imports nothing of the program."""
