"""Material ensembles of the tsx tunnel (`ensemble.py`)."""
