"""The plain reference that decides ``correct``: a frozen copy of the
port's plain PyTorch code (``frozen/``, see its docstring), drivers that
follow a cell's first steps from the seed as the program's Trainer does
(``stage1.py``, ``stage0.py``), the replay of the program's tracer answers
with their brute-force judge (``replay.py``, ``brute.py``) and the
comparison (``compare.py``).  Nothing here imports the program."""
