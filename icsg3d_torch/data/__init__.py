"""Host data helpers: packed GridDataset store and condition binning."""
