"""Camera geometry (RPC)."""
