"""FLOP and byte counts of the cells' work, and the peaks they divide by."""
