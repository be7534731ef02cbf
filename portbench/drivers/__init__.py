"""Kinds of run, one file each (``workloads/<cell>.json`` names its driver)."""
