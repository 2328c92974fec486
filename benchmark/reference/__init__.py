"""The plain reference the benchmark judges the program against.

Plain NumPy and PyTorch in float64: a frozen copy of the heap-tree
covariance interpreter (``heap.py``), the host layer's data rules
(``data.py``: Box-Cox, normalisation, schedule and capacities), the GP
log marginal likelihood and predictive (``gp.py``) and the scores
(``scoring.py``).  It imports nothing of the program under test.
"""
