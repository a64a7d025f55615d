"""One reader a per-layer metric, ``<metric>.py`` with ``read(records)``:
the value, or None where the run left nothing to read."""
