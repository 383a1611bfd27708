"""Atomic step snapshots of a solve's carry (checkpoint/manager.py)."""
