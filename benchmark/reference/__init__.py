"""The plain references the benchmark's checks compare with. They
import nothing of the program under test."""
