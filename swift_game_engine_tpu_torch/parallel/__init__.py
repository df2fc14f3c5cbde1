"""Multi-device execution: the image plane sharded over ranks
(``sharding.py``)."""
