"""Datasets: the synthetic multi-traversal road block (`synthetic.py`).
The nuPlan loaders are not ported yet."""
