from .csvlog import CSV_COLUMNS, CsvLogger  # noqa: F401
from .profile import ProfileResult, benchmark, time_phases, trace  # noqa: F401
