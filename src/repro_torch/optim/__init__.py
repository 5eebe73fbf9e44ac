"""AdamW on parameter shards, and the deprecated compression shims."""
