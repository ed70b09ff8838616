"""The plain reference the program's answers are judged against."""
