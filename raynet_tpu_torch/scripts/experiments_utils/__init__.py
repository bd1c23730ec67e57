from .experiments_manager import (  # noqa: F401
    GspreadSheetsClient,
    Metrics,
    MetricsHistory,
    build_registration_row,
    experiment_tag,
    load_params_ordering,
    register_experiment,
    save_experiment_locally,
    set_output_directory,
)
