"""Datasets: the synthetic multi-traversal road block (`synthetic.py`) and
the nuPlan road-block layer (`nuplan.py`, `dataset.py`, `loader.py`), which
reads its images with the port's own decoders (`image_io.py`)."""
