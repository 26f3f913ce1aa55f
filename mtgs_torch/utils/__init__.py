"""Host utilities: point-cloud IO and filtering."""
