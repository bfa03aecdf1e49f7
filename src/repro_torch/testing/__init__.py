"""Test harness of the port: multi-rank runs on gloo."""
