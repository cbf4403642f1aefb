"""Incubating ops of the port."""
