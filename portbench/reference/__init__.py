"""The benchmark's plain reference: a QMF codec in plain PyTorch, NumPy,
SciPy's LAPACK and zlib (`codec.py`), and the comparison that decides a
run's `correct` (`compare.py`). Nothing here imports the program."""
