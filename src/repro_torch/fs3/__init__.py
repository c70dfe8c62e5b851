"""3FS in the port: a copy of the JAX package's pure-Python 3FS
(``repro/fs3``), its msgpack bytes from the port's own codec
(``fs3/codec.py``)."""
from repro_torch.fs3.client import DEFAULT_CHUNK, FS3Client, FS3Cluster
from repro_torch.fs3.kv import FS3KV, FS3Queue

__all__ = ["FS3Client", "FS3Cluster", "FS3KV", "FS3Queue", "DEFAULT_CHUNK"]
