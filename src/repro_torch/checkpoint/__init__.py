"""Checkpoint store (port of ``repro.checkpoint``): atomic step directories
in the reference's on-disk format, so either package restores the other's."""
