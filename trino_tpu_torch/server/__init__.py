"""HTTP server + client protocol layer: the statement server
(``protocol.py``) and its client (``client.py``)."""

from .protocol import QueryDispatcher, TrinoTpuServer  # noqa: F401
from .client import Client  # noqa: F401
