"""Launchers: the join, join-serving and LM-serving command lines."""
