"""Host-side telemetry of the port (own copy of what it needs from the reference)."""
