"""Helpers of the port that need no card."""
