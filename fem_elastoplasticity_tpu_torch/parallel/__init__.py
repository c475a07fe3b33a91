"""Material ensembles of the tsx tunnel (`ensemble.py`) and multi-device
runs over torch.distributed (`sharding.py`)."""
