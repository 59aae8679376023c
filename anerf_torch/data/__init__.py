"""Host-side data layer: the h5 schema, datasets and the batch loader."""
