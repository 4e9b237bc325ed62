"""The plain references that decide ``correct``: numpy only, importing
nothing of the program under test."""
