"""The plain NumPy reference of the garbled-circuit ops and the comparison
that decides a run's ``correct``. Imports nothing of the program."""
