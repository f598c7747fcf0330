"""The ETL handoff: weather.csv -> the processed parquet the trainer reads."""
