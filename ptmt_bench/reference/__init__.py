"""The benchmark's plain reference and the comparison that decides
``correct``; imports torch and numpy only, nothing of the program."""
