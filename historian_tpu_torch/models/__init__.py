"""Substitution and indel models of the port, with the preset models."""
