"""Data parallelism of the port (``mesh.py``) and the distributed
systematic resampler (``resample.py``)."""
