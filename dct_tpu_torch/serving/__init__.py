"""Score packages, request parsing, micro-batching and the HTTP scoring server."""
