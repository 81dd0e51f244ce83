"""One reader a metric, ``<metric>.py`` with ``read(view)``: a number, or
None where the run holds nothing for it to read (the harness then leaves
the metric out). ``solve_bytes.py`` holds the byte count of the solve's
roofline share."""
