"""The harness: finding a cell's pieces (``spec``), running one cell
(``cell``), the networks the traffic drivers share (``networks``), the
traced window (``trace``) and the table of peaks (``peaks``)."""
