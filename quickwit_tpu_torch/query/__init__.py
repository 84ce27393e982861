"""Query AST, tokenizers and aggregation specs."""
