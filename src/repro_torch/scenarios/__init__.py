from repro_torch.scenarios.base import (DRAWS, PRESETS, TRANSITIONS,
                                        ScenarioSpec, ScenarioState, advance,
                                        advance_dynamic, diurnal_transition,
                                        draw_shapes, draw_size,
                                        flash_crowd_transition,
                                        init_scenario, preset,
                                        regional_outage_transition,
                                        register_transition,
                                        static_transition,
                                        unpack_draws)

__all__ = [
    "DRAWS", "PRESETS", "TRANSITIONS", "ScenarioSpec", "ScenarioState",
    "advance", "advance_dynamic", "diurnal_transition", "draw_shapes",
    "draw_size", "flash_crowd_transition", "init_scenario", "preset",
    "regional_outage_transition", "register_transition",
    "static_transition", "unpack_draws",
]
