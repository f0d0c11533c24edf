"""Host data helpers: packed GridDataset store and batch iterator,
train/validation splits, and condition binning."""
