"""The training step and its ZeRO++ policy."""
