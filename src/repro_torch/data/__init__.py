"""Synthetic datasets (a copy of ``repro.data.vectors``: numpy only, so a
seed gives the same data in both packages)."""
