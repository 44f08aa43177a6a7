"""Plain references the cells are judged against."""
