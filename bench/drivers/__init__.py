"""Drivers, one per kind of traffic: each builds the system under test from
the seed, warms the cell's shapes, runs the window, and compares what the
window produced with the plain reference (``run(cfg, traffic, cell, ctx)
-> harness.Outcome``)."""
