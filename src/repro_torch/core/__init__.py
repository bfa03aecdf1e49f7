"""Quantization, flat partitions, collectives and the ZeRO++ gather engine."""
