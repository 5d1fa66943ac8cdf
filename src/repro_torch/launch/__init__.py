"""Launchers: the join command line."""
