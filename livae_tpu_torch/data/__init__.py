"""Host site tables and on-device patch extraction."""
