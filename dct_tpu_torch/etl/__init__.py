"""ETL state the trainer reads (the ETL itself is a later slice)."""
