from repro_torch.core.baselines.common import BaseOptimizer, run_method, MethodResult
from repro_torch.core.baselines.grid import GridSearch
from repro_torch.core.baselines.random_walk import RandomWalker
from repro_torch.core.baselines.bo import BayesianOptimization
from repro_torch.core.baselines.ga import GeneticAlgorithm
from repro_torch.core.baselines.aco import AntColony

METHODS = {
    "GS": GridSearch,
    "RW": RandomWalker,
    "BO": BayesianOptimization,
    "GA": GeneticAlgorithm,
    "ACO": AntColony,
}

__all__ = ["BaseOptimizer", "run_method", "MethodResult", "GridSearch",
           "RandomWalker", "BayesianOptimization", "GeneticAlgorithm",
           "AntColony", "METHODS"]
