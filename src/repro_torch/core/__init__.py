"""Spec layer, artifact reader, integer datapath and CU runners."""
