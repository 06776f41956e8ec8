"""Host-side data pipeline: slot records, datasets, batch packing."""
