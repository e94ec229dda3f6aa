"""Serving layer: the OpenAI-compatible HTTP API on PyTorch.

The counterpart of the JAX package's `server/` for one replica: `api.py`
(the server, its Batcher and its recovery), `scheduler.py` (SLO classes),
`quarantine.py` (poison-request strikes) and the part of `router.py` the
server needs (the prefix chain keys the gateway re-homes affinity by).
The gateway stays the JAX package's (`distributed_llama_tpu.server.gateway`,
stdlib only): it fronts a port replica as it fronts a JAX one.
"""


def parse_query(query: str) -> dict:
    """Parse an already-split query string (``a=1&b=2``) into a dict — the
    one copy both servers' control endpoints share. No URL-decoding: the
    only consumers are our own hex trace ids and backend keys."""
    return dict(kv.split("=", 1) for kv in query.split("&") if "=" in kv)
