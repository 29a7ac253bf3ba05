"""The plain fp32 reference that decides ``correct``: a frozen copy of the
architecture that imports nothing of the program under test."""
