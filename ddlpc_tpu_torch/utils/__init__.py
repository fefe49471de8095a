"""Stdlib helpers: atomic small-file writes and the DWZ1 wire codec."""
