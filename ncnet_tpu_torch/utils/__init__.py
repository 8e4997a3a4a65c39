"""Host-side helpers of the port: seeding and atomic file writes."""
