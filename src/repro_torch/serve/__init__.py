"""Serving front ends."""
