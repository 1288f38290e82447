"""Runners of the port, one a kind of traffic (a traffic file names its runner)."""
