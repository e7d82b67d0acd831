"""Helpers of the port: device resolution and parameter carry-over."""
