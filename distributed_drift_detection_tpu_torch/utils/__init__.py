"""Host-side helpers of the port (no device code)."""
