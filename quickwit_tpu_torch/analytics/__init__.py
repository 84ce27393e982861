"""SQL analytics over the search path (sql.py)."""

from .sql import SqlError, execute_sql, parse_sql

__all__ = ["SqlError", "execute_sql", "parse_sql"]
