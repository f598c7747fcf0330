"""Data front: row arrays, sliding windows, splits and the batch loader."""
